"""Decoder-only transformer stack of the port: dense GQA, MoE (with GQA
or MLA attention) and pure-SSM (Mamba-2) families.

Counterpart of ``repro/models/transformer.py``.  Layer parameters are
stacked along a leading L axis, as in the reference; a Python loop over
``range(L)`` on views of the stack replaces ``lax.scan``.  Non-uniform
prefix layers (DeepSeek's dense first layer) are a ``first_layers`` list
run before the stack, with their own caches and pools.  Decode caches and
paged pools are updated in place (the reference threads them through the
scan as carry and donates the buffers), so a decode step allocates no copy
of either.

Modes:
  train   -- causal forward, logits for all positions, no cache
  prefill -- causal forward + returns the decode cache
  decode  -- single-token step against a dense cache or, when the cache
             holds ``block_tables`` (GQA, MLA) or ``slab_ids`` (SSM),
             against block or slab pools
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MoE
from repro_torch.models import ssm as S


def _dtype(cfg, dtype=None) -> torch.dtype:
    return dtype if dtype is not None else getattr(torch, cfg.dtype)


# --------------------------------------------------------------------------
# per-layer init
# --------------------------------------------------------------------------


def _mixer_kind(cfg) -> str:
    if cfg.family == "ssm":
        return "mamba"
    return cfg.attn_type  # gqa | mla


def _n_first(cfg) -> int:
    """Dense prefix layers run before the stack (MoE stacks only)."""
    return cfg.first_dense_layers if cfg.is_moe else 0


def init_layer(cfg, generator, dtype, device, *, use_moe: bool = False,
               d_ff: int | None = None):
    p = {"ln1": L.init_rms_norm(cfg.d_model, dtype, device)}
    kind = _mixer_kind(cfg)
    if kind == "mamba":
        p["mamba"] = S.init_mamba2(cfg, generator, dtype, device)
        return p  # SSM blocks: mixer only, no separate MLP
    if kind == "mla":
        p["attn"] = L.init_mla(cfg, generator, dtype, device)
    else:
        p["attn"] = L.init_attention(cfg, generator, dtype, device)
    p["ln2"] = L.init_rms_norm(cfg.d_model, dtype, device)
    if use_moe:
        p["moe"] = MoE.init_moe(cfg, generator, dtype, device)
    else:
        p["mlp"] = L.init_mlp(cfg, generator, dtype, device, d_ff=d_ff)
    return p


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _layer(tree, i: int):
    return _tree_map(lambda t: t[i], tree)


def _init_stacked(n: int, make_layer):
    """``n`` layers from ``make_layer()`` stacked along a leading axis.
    Each stacked leaf is allocated once and filled layer by layer, so the
    peak is the stack plus one layer's weights (and that layer's fp32
    draws), not two copies of the stack."""
    tree = make_layer()
    stack = _tree_map(lambda t: t.new_empty((n, *t.shape)), tree)
    for i in range(n):
        if i:
            tree = make_layer()
        _tree_map(lambda dst, src: dst[i].copy_(src), stack, tree)
        tree = None
    return stack


def init_params(cfg, *, generator: torch.Generator, device=None):
    """Random weights with the reference's distributions (not its numbers:
    ``torch.Generator`` and ``jax.random`` differ), drawn in the
    reference's order: embedding, prefix layers, stack, final norm, head."""
    device = resolve_device(device)
    dtype = _dtype(cfg)
    params: dict = {
        "embed": L.embed_init(generator, (cfg.vocab_size, cfg.d_model),
                              dtype, device)}
    n_first = _n_first(cfg)
    if n_first:
        params["first_layers"] = [
            init_layer(cfg, generator, dtype, device, d_ff=cfg.d_ff)
            for _ in range(n_first)]
    params["layers"] = _init_stacked(
        cfg.num_layers - n_first,
        lambda: init_layer(cfg, generator, dtype, device,
                           use_moe=cfg.is_moe,
                           d_ff=cfg.moe_d_ff if cfg.is_moe else cfg.d_ff))
    params["final_norm"] = L.init_rms_norm(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), dtype, device)
    return params


# --------------------------------------------------------------------------
# block
# --------------------------------------------------------------------------


def block(cfg, p, x, *, positions, mode: str, layer_cache=None,
          lengths=None, mrope_positions=None, step=None):
    """One transformer block.  Returns (x, new_layer_cache, aux): aux is
    the MoE load-balance loss of a block with ``moe`` weights, else None.
    ``lengths`` (B,) are the true prompt lengths of a padded prefill; only
    the SSM prefill needs them (pad positions would otherwise enter its
    state).  ``mrope_positions`` (3, B, S) drive M-RoPE where the config
    has it; ``step`` is the step's shared attention values
    (``layers.StepValues``), computed by the attention when None."""
    kind = _mixer_kind(cfg)
    h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    if kind == "mamba":
        if mode == "prefill":
            out, new_cache = S.prefill_mamba_cache(cfg, p["mamba"], h,
                                                   lengths=lengths)
        else:
            out, new_cache = S.mamba2_block(cfg, p["mamba"], h,
                                            layer_cache=layer_cache)
        return x + out, new_cache, None
    cache_flag = "build" if mode == "prefill" else None
    if kind == "mla":
        out, new_cache = L.mla_attention(
            cfg, p["attn"], h, positions=positions, cache=cache_flag,
            layer_cache=layer_cache, step=step)
    else:
        out, new_cache = L.attention(
            cfg, p["attn"], h, positions=positions, cache=cache_flag,
            layer_cache=layer_cache, mrope_positions=mrope_positions,
            step=step)
    x = x + out
    h = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    if "moe" in p:
        out, aux = MoE.moe_layer(cfg, p["moe"], h)
        return x + out, new_cache, aux
    return x + L.mlp(cfg, p["mlp"], h), new_cache, None


# --------------------------------------------------------------------------
# cache construction
# --------------------------------------------------------------------------


def _cache_leaves(cfg, lead: tuple, rows: int, seq: int | None, dtype,
                  device, kind: str | None = None):
    """Zero cache leaves of one mixer kind (``kind``, default the stack's
    ``_mixer_kind``) with leading axes ``lead``: ``rows`` sequences of
    ``seq`` positions (dense caches, or pools of ``rows`` blocks of ``seq``
    positions), or ``rows`` SSM slabs when ``seq`` is None.  Every leaf is
    its own zeroed storage."""
    kind = kind or _mixer_kind(cfg)
    if kind == "mamba":
        return (
            torch.zeros((*lead, rows, cfg.conv_width - 1, S.conv_dim(cfg)),
                        dtype=dtype, device=device),
            torch.zeros((*lead, rows, cfg.ssm_nheads, cfg.ssm_head_dim,
                         cfg.ssm_state_dim), dtype=torch.float32,
                        device=device))
    if kind == "mla":
        widths = ((cfg.kv_lora_rank,), (cfg.qk_rope_head_dim,))
    else:
        widths = ((cfg.num_kv_heads, cfg.head_dim),) * 2
    return tuple(torch.zeros((*lead, rows, seq, *w), dtype=dtype,
                             device=device) for w in widths)


def init_cache(cfg, batch: int, max_seq: int, dtype=None, *, device=None):
    """Zero dense decode cache and the per-row position counter: (k, v)
    stacks (L, B, max_seq, Nkv, H); for MLA (c_kv, k_rope) stacks
    (L, B, max_seq, r) / (L, B, max_seq, pr); for SSM (conv, state) stacks
    (L, B, W-1, C) and (L, B, H, P, N) fp32.  Prefix layers add
    ``first_layers``, one (B, ...) tuple per layer."""
    device = resolve_device(device)
    dt = _dtype(cfg, dtype)
    n_first = _n_first(cfg)
    cache = {"layers": _cache_leaves(cfg, (cfg.num_layers - n_first,), batch,
                                     max_seq, dt, device),
             "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if n_first:
        cache["first_layers"] = [
            _cache_leaves(cfg, (), batch, max_seq, dt, device)
            for _ in range(n_first)]
    return cache


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
    pools, MLA latent block pools (smaller rows, same tables) and SSM
    state-slab pools.  MoE prefix layers ride along as an extra pool with
    their own leading axis."""
    return cache_family(cfg) in ("gqa", "mla", "ssm")


def init_paged_cache(cfg, num_blocks: int, block_size: int, dtype=None, *,
                     num_slabs: int = 0, num_segments: int = 0, device=None):
    """Zero pooled decode cache, keyed as :func:`paged_pool_kinds`:

      gqa -- ``layers``: (k, v) block pools (L, NB, BS, Nkv, H)
      mla -- ``layers``: (c_kv, k_rope) block pools (L, NB, BS, r) /
             (L, NB, BS, pr); MoE prefix layers add ``first_layers`` with
             their own leading axis
      ssm -- ``layers``: (conv, state) slab pools (L, NS, W-1, C) and
             (L, NS, H, P, N) fp32 -- constant size, one slab per stream

    Block tables, slab ids and lengths are not part of it: the serving
    engine passes them per decode call."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged decode cache unsupported for family={cfg.family!r} "
            f"(cache family {cache_family(cfg)!r})")
    device = resolve_device(device)
    dt = _dtype(cfg, dtype)
    slabs = cache_family(cfg) == "ssm"
    rows = num_slabs if slabs else num_blocks
    seq = None if slabs else block_size
    n_first = _n_first(cfg)
    pools = {"layers": _cache_leaves(cfg, (cfg.num_layers - n_first,), rows,
                                     seq, dt, device)}
    if n_first:
        pools["first_layers"] = _cache_leaves(cfg, (n_first,), rows, seq, dt,
                                              device)
    return pools


def paged_pool_kinds(cfg) -> dict[str, str]:
    """Pool-kind map for the engine's staging: pools-dict key -> "block" |
    "slab"."""
    kind = "slab" if cache_family(cfg) == "ssm" else "block"
    kinds = {"layers": kind}
    if _n_first(cfg):
        kinds["first_layers"] = kind
    return kinds


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def embed_tokens(cfg, params, tokens):
    return params["embed"][tokens.long()]


def unembed(cfg, params, x):
    """fp32 logits (the reference accumulates and returns fp32).  A bf16
    ``x`` on the card takes one GEMM of the bf16 table with fp32
    accumulation and output, as the reference's ``preferred_element_type``
    does -- no fp32 copy of the table -- and so does one on the meta
    device, where static pricing follows the card's path; CPU tensors (no
    such kernel there) and fp32 cast to fp32 first, the same arithmetic."""
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if x.device.type != "cpu" and x.dtype != torch.float32:
        b, s, d = x.shape
        return torch.mm(x.reshape(b * s, d), table,
                        out_dtype=torch.float32).view(b, s, -1)
    return torch.matmul(x.float(), table.float())


def forward(cfg, params, batch, *, mode: str, cache=None):
    """batch: dict with 'tokens' (B,S) (or 'embeds' (B,S,D) for stacks that
    take embeddings), optional 'mrope_positions' (3,B,S) (M-RoPE; (3,B,1)
    in decode), 'lengths' (B,) true prompt lengths of a padded prefill and
    'max_seq' (the prefill cache's padded length).  Returns (logits,
    new_cache, aux_loss).  The values every attention layer shares (rope,
    each row's slot and length in decode) are computed once, at the first
    attention layer, and passed to the others."""
    if cfg.embed_inputs and "embeds" in batch:
        x = batch["embeds"]
    else:
        x = embed_tokens(cfg, params, batch["tokens"])
    b, s, _ = x.shape

    if mode == "decode":
        positions = cache["pos"][:, None]
    else:
        positions = torch.arange(s, device=x.device).expand(b, s)
    mrope_positions = batch.get("mrope_positions")
    if cfg.rope_theta == 0.0:  # absolute sinusoidal (whisper-style)
        x = x + L.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)

    paged = mode == "decode" and cache is not None and (
        "block_tables" in cache or "slab_ids" in cache)
    lengths = batch.get("lengths") if mode == "prefill" else None
    kind = _mixer_kind(cfg)
    mamba = kind == "mamba"
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    step = None

    def run(p, x, key, li):
        """Block ``li`` of ``params[key]`` (the prefix list or the stack),
        against the cache entry of the same key in decode."""
        nonlocal aux_total, step
        if paged and mamba:
            lc = (*cache[key], li, cache["slab_ids"])
        elif paged:  # gqa / mla block pools share the table indirection
            lc = (*cache[key], li, cache["block_tables"], cache["pos"])
        elif mode == "decode":  # the stack's leaves, or the prefix's tuple
            dense = (tuple(t[li] for t in cache[key]) if key == "layers"
                     else cache[key][li])
            lc = (*dense, cache["pos"])
        else:
            lc = None
        if step is None and not mamba:
            step = (L.mla_step(cfg, positions, lc) if kind == "mla" else
                    L.attention_step(cfg, positions, lc, mrope_positions))
        x, c, aux = block(cfg, p, x, positions=positions, mode=mode,
                          layer_cache=lc, lengths=lengths,
                          mrope_positions=mrope_positions, step=step)
        if aux is not None:
            aux_total = aux_total + aux
        return x, c

    # prefix (non-stacked) layers, then the stack
    first = []
    for i, p in enumerate(params.get("first_layers", ())):
        x, c = run(p, x, "first_layers", i)
        first.append(c)
    stack = params["layers"]
    ks, vs = [], []
    for li in range(stack["ln1"]["scale"].shape[0]):
        x, c = run(_layer(stack, li), x, "layers", li)
        if mode == "prefill":
            ks.append(c[0])
            vs.append(c[1])

    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(cfg, params, x)

    if mode == "train":
        return logits, None, aux_total
    if mode == "prefill":
        # per-row true lengths: bucketed prefill batching pads same-bucket
        # prompts to a common length; rows past ``lengths[b]`` hold padding
        # KV that decode masks (and progressively overwrites)
        pos = (lengths.to(torch.int32) if lengths is not None
               else torch.full((b,), s, dtype=torch.int32, device=x.device))
        out_cache = {"layers": (torch.stack(ks), torch.stack(vs)), "pos": pos}
        if first:
            out_cache["first_layers"] = first
        if mamba:  # constant-size state: no sequence axis to pad
            return logits, out_cache, aux_total
        return logits, _pad_prefill_cache(cfg, out_cache,
                                          batch.get("max_seq", s)), aux_total
    out_cache = {"layers": cache["layers"], "pos": cache["pos"] + 1}
    for key in ("first_layers", "block_tables", "slab_ids"):
        if key in cache:
            out_cache[key] = cache[key]
    return logits, out_cache, aux_total


def pad_seq(x, axis: int, max_seq: int):
    """``x`` grown to ``max_seq`` along ``axis`` with zeros (as it is when
    already that long)."""
    if x.shape[axis] >= max_seq:
        return x
    out = x.new_zeros((*x.shape[:axis], max_seq, *x.shape[axis + 1:]))
    out.narrow(axis, 0, x.shape[axis]).copy_(x)
    return out


def _pad_prefill_cache(cfg, cache, max_seq: int):
    """Grow the prefill cache to max_seq along the sequence axis with
    zeros: axis 2 of the stacked (L, B, S, ...) leaves, axis 1 of the
    prefix layers' (B, S, ...) leaves."""
    cache = dict(cache)
    cache["layers"] = tuple(pad_seq(t, 2, max_seq) for t in cache["layers"])
    if "first_layers" in cache:
        cache["first_layers"] = [tuple(pad_seq(t, 1, max_seq) for t in leaves)
                                 for leaves in cache["first_layers"]]
    return cache
