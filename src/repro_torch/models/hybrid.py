"""Zamba2-style hybrid stack of the port: a Mamba-2 backbone with one
SHARED attention+MLP block applied every ``attn_every`` layers (one set of
weights for every application; real Zamba2's per-use LoRA deltas are
omitted, as in the reference).

Counterpart of ``repro/models/hybrid.py``, with its layout: the depth is
G groups of [(attn_every - 1) Mamba-2 layers + one shared-block
application], then R tail Mamba-2 layers, with G = num_layers //
attn_every.  Group weights are stacked (G, PG, ...), the tail (R, ...).
Python loops over views of the stacks replace the reference's nested
``lax.scan``.  Decode caches and pools are updated in place, as in
``transformer.py``.

Paged decode rides two pool kinds in one call: the shared block's KV
block pools ``attn`` (G, NB, BS, Nkv, H), one plane per application,
addressed by group index through ONE block table per row; and the Mamba-2
state slab pools ``mamba`` (G*PG + R, NS, ...), addressed by the flat
Mamba-2 layer index through one slab id per row.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T


def _split(cfg) -> tuple[int, int, int]:
    """(G groups, PG Mamba-2 layers per group, R tail layers)."""
    g = cfg.num_layers // cfg.attn_every
    per_group = cfg.attn_every - 1
    tail = cfg.num_layers - g * cfg.attn_every
    return g, per_group, tail


def init_mamba_layer(cfg, generator, dtype, device):
    return {"ln1": L.init_rms_norm(cfg.d_model, dtype, device),
            "mamba": S.init_mamba2(cfg, generator, dtype, device)}


def init_params(cfg, *, generator: torch.Generator, device=None):
    """Random weights with the reference's distributions, drawn in its
    order: embedding, group layers, shared block, tail, final norm, head.
    The stacks are filled layer by layer (``transformer._init_stacked``)."""
    device = resolve_device(device)
    dtype = T._dtype(cfg)
    g, per_group, tail = _split(cfg)
    make = lambda: init_mamba_layer(cfg, generator, dtype, device)
    params: dict = {
        "embed": L.embed_init(generator, (cfg.vocab_size, cfg.d_model),
                              dtype, device)}
    params["groups"] = T._tree_map(
        lambda t: t.view(g, per_group, *t.shape[1:]),
        T._init_stacked(g * per_group, make))
    params["shared_attn"] = {
        "ln1": L.init_rms_norm(cfg.d_model, dtype, device),
        "attn": L.init_attention(cfg, generator, dtype, device),
        "ln2": L.init_rms_norm(cfg.d_model, dtype, device),
        "mlp": L.init_mlp(cfg, generator, dtype, device),
    }
    if tail:
        params["tail"] = T._init_stacked(tail, make)
    params["final_norm"] = L.init_rms_norm(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), dtype, device)
    return params


def init_cache(cfg, batch: int, max_seq: int, dtype=None, *, device=None):
    """Zero dense decode cache: ``groups_mamba`` (conv, state) stacks
    (G, PG, B, W-1, C) and (G, PG, B, H, P, N) fp32; ``groups_attn`` (k, v)
    (G, B, max_seq, Nkv, H), one plane per shared-block application;
    ``tail`` (R, B, ...); ``pos`` (B,).  Every group's cache is its own
    storage (the reference broadcasts one zero cache, which JAX may share;
    here decode writes in place)."""
    device = resolve_device(device)
    dt = T._dtype(cfg, dtype)
    g, per_group, tail = _split(cfg)
    cache = {
        "groups_mamba": T._cache_leaves(cfg, (g, per_group), batch, None, dt,
                                        device, kind="mamba"),
        "groups_attn": T._cache_leaves(cfg, (g,), batch, max_seq, dt, device,
                                       kind="gqa"),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if tail:
        cache["tail"] = T._cache_leaves(cfg, (tail,), batch, None, dt, device,
                                        kind="mamba")
    return cache


def cache_family(cfg) -> str | None:
    """Hybrid stacks must declare their family (``cache_family='hybrid'``):
    two pool kinds ride one step, nothing derivable to fall back on."""
    return getattr(cfg, "cache_family", "") or None


def supports_paged(cfg) -> bool:
    return cache_family(cfg) == "hybrid"


def init_paged_cache(cfg, num_blocks: int, block_size: int, dtype=None, *,
                     num_slabs: int = 0, num_segments: int = 0, device=None):
    """Both pool kinds of the stack: ``attn`` -- the shared block's (k, v)
    block pools (G, NB, BS, Nkv, H), every application addressing the same
    per-row block table in its own plane; ``mamba`` -- (conv, state) slab
    pools (G*PG + R, NS, W-1, C) and (G*PG + R, NS, H, P, N) fp32, the
    Mamba-2 layers flattened onto one leading axis."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged decode cache unsupported for family={cfg.family!r}")
    device = resolve_device(device)
    dt = T._dtype(cfg, dtype)
    g, per_group, tail = _split(cfg)
    return {
        "attn": T._cache_leaves(cfg, (g,), num_blocks, block_size, dt, device,
                                kind="gqa"),
        "mamba": T._cache_leaves(cfg, (g * per_group + tail,), num_slabs,
                                 None, dt, device, kind="mamba"),
    }


def paged_pool_kinds(cfg) -> dict[str, str]:
    return {"attn": "block", "mamba": "slab"}


def paged_insert_views(cfg, prefill_cache) -> dict:
    """The prefill cache's leaves arranged like :func:`init_paged_cache`'s
    pools ((Laxis, B, ...) per leaf) for the engine's insert scatter: the
    group planes as they are, the Mamba-2 caches flattened to
    (G*PG + R, B, ...)."""
    g, per_group, tail = _split(cfg)

    def flat(i):
        grp = prefill_cache["groups_mamba"][i]  # (G, PG, B, ...)
        out = grp.reshape(g * per_group, *grp.shape[2:])
        if tail:
            out = torch.cat([out, prefill_cache["tail"][i]], 0)
        return out

    return {"attn": prefill_cache["groups_attn"], "mamba": (flat(0), flat(1))}


def _mamba_sub(cfg, p, x, *, mode, layer_cache, lengths=None):
    h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    if mode == "prefill":
        out, c = S.prefill_mamba_cache(cfg, p["mamba"], h, lengths=lengths)
    else:
        out, c = S.mamba2_block(cfg, p["mamba"], h, layer_cache=layer_cache)
    return x + out, c


def forward(cfg, params, batch, *, mode: str, cache=None, remat: bool = False,
            remat_policy: str | None = None):
    """batch: 'tokens' (B,S), optional 'lengths' (B,) true prompt lengths of
    a padded prefill (they reach the Mamba-2 layers only: the shared
    block's padded KV is masked by decode) and 'max_seq' (the prefill
    cache's padded length).  Decode takes the dense cache of
    :func:`init_cache` or, when the cache holds ``block_tables``, the pools
    of :func:`init_paged_cache` with ``block_tables`` (B, W), ``slab_ids``
    (B,) and ``pos`` (B,).  Returns (logits, new_cache, aux_loss).
    ``remat`` runs each group (its Mamba-2 layers and the shared block) as
    one checkpointed unit, as the reference's ``jax.checkpoint`` of its
    group body does (``transformer.remat_layer``); the tail is not."""
    x = shd.shard_hidden(T.embed_tokens(cfg, params, batch["tokens"]))
    b, s, _ = x.shape
    g, per_group, tail = _split(cfg)
    if mode == "decode":
        positions = cache["pos"][:, None]
    else:
        positions = torch.arange(s, device=x.device).expand(b, s)
    lengths = batch.get("lengths") if mode == "prefill" else None
    paged = mode == "decode" and cache is not None and "block_tables" in cache
    dense = mode == "decode" and not paged
    shared = params["shared_attn"]
    convs, states, ks, vs = [], [], [], []  # the prefill cache, per layer
    step = None  # the shared block's rope and slots, once per step

    def mamba(p, x, li, leaves):
        """Mamba-2 layer ``li`` of the flat index (G*PG + R), against its
        slab pools, its dense cache ``leaves`` or no cache."""
        if paged:
            lc = (*cache["mamba"], li, cache["slab_ids"])
        elif dense:
            lc = (*leaves, cache["pos"])
        else:
            lc = None
        x, c = _mamba_sub(cfg, p, x, mode=mode, layer_cache=lc,
                          lengths=lengths)
        if mode == "prefill":
            convs.append(c[0])
            states.append(c[1])
        return x

    def group(gi, x, lc, step):
        """Group ``gi``: its Mamba-2 layers, then the shared block's
        application gi against ``lc``."""
        for j in range(per_group):
            x = mamba(T._tree_map(lambda t: t[gi, j], params["groups"]), x,
                      gi * per_group + j,
                      tuple(t[gi, j] for t in cache["groups_mamba"])
                      if dense else None)
        x, c, _ = T.block(cfg, shared, x, positions=positions, mode=mode,
                          layer_cache=lc, step=step)
        return x, c

    run_group = T.remat_layer(group, remat, remat_policy)
    for gi in range(g):
        # the shared block's application gi: KV plane gi of the cache or
        # pools, every plane through the same block table
        if paged:
            lc = (*cache["attn"], gi, cache["block_tables"], cache["pos"])
        elif dense:
            lc = (*(t[gi] for t in cache["groups_attn"]), cache["pos"])
        else:
            lc = None
        if step is None:  # shared by every application of this step
            step = L.attention_step(cfg, positions, lc)
        x, c = run_group(gi, x, lc, step)
        if mode == "prefill":
            ks.append(c[0])
            vs.append(c[1])
    for r in range(tail):
        x = mamba(T._layer(params["tail"], r), x, g * per_group + r,
                  tuple(t[r] for t in cache["tail"]) if dense else None)

    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = T.unembed(cfg, params, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if mode == "train":
        return logits, None, aux
    if mode == "decode":
        keys = (("attn", "mamba", "block_tables", "slab_ids") if paged
                else ("groups_mamba", "groups_attn", "tail"))
        out = {k: cache[k] for k in keys if k in cache}
        out["pos"] = cache["pos"] + 1
        if not paged:
            out["groups_attn"] = tuple(
                shd.shard_cache_seq(t, batch_axis=1, seq_axis=2)
                for t in out["groups_attn"])
        return logits, out, aux
    # prefill: only the shared block's KV has a sequence axis to pad
    max_seq = batch.get("max_seq", s)
    n = g * per_group
    conv, state = torch.stack(convs), torch.stack(states)
    out = {
        "groups_mamba": (conv[:n].view(g, per_group, *conv.shape[1:]),
                         state[:n].view(g, per_group, *state.shape[1:])),
        "groups_attn": tuple(
            shd.shard_cache_seq(T.pad_seq(torch.stack(t), 2, max_seq),
                                batch_axis=1, seq_axis=2) for t in (ks, vs)),
        "pos": (lengths.to(torch.int32) if lengths is not None
                else torch.full((b,), s, dtype=torch.int32, device=x.device)),
    }
    if tail:
        out["tail"] = (conv[n:], state[n:])
    return logits, out, aux
