"""Whisper-style encoder-decoder stack of the port.

Counterpart of ``repro/models/encdec.py``, with its layout and its stub:
the audio frontend (log-mel + conv1d subsampling) is not modelled, the
encoder consumes frame embeddings (B, encoder_seq, d_model), and positions
are sinusoidal on both sides.  Encoder and decoder weights are stacked
along a leading L axis (``encoder``, ``decoder``); Python loops over views
of the stacks replace the reference's ``lax.scan``.

Attention runs on the port's kernels: the bidirectional encoder and the
cross-attention of prefill and train on ``flash_attention(causal=False)``
(the cross half with S the prompt and Sk the encoder's frames); the
decoder's causal self-attention through ``layers.attention`` (flash,
paged or dense decode); the cross-attention of decode on
``decode_attention`` with every row's length the encoder's, over the dense
cross cache or, paged, over the shared segment pools addressed by each
row's ``segment_ids`` (read in place, never gathered).

Decode cache, per decoder layer: the growing self-attention K/V and the
cross-attention K/V computed once from the encoder output at prefill.
Paged, the self K/V live in block pools and the cross K/V in refcounted
read-only segment pools that streams of the same encoder output share.
Decode caches and pools are updated in place, as in ``transformer.py``.
"""

from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


# the reference's cross-attention init draws self-attention's leaves:
# wq (d, n, hd), wk / wv (d, nkv, hd), wo (n, hd, d) at the same scales
init_cross_attention = L.init_attention


def init_encoder_layer(cfg, generator, dtype, device):
    return {
        "ln1": L.init_rms_norm(cfg.d_model, dtype, device),
        "attn": L.init_attention(cfg, generator, dtype, device),
        "ln2": L.init_rms_norm(cfg.d_model, dtype, device),
        "mlp": L.init_mlp(cfg, generator, dtype, device),
    }


def init_decoder_layer(cfg, generator, dtype, device):
    return {
        "ln1": L.init_rms_norm(cfg.d_model, dtype, device),
        "attn": L.init_attention(cfg, generator, dtype, device),
        "ln_x": L.init_rms_norm(cfg.d_model, dtype, device),
        "cross": init_cross_attention(cfg, generator, dtype, device),
        "ln2": L.init_rms_norm(cfg.d_model, dtype, device),
        "mlp": L.init_mlp(cfg, generator, dtype, device),
    }


def init_params(cfg, *, generator: torch.Generator, device=None):
    """Random weights with the reference's distributions, drawn in its
    order: embedding, encoder stack, encoder norm, decoder stack, final
    norm, head.  The stacks are filled layer by layer
    (``transformer._init_stacked``)."""
    device = resolve_device(device)
    dtype = T._dtype(cfg)
    params: dict = {
        "embed": L.embed_init(generator, (cfg.vocab_size, cfg.d_model),
                              dtype, device)}
    params["encoder"] = T._init_stacked(
        cfg.encoder_layers,
        lambda: init_encoder_layer(cfg, generator, dtype, device))
    params["enc_norm"] = L.init_rms_norm(cfg.d_model, dtype, device)
    params["decoder"] = T._init_stacked(
        cfg.num_layers,
        lambda: init_decoder_layer(cfg, generator, dtype, device))
    params["final_norm"] = L.init_rms_norm(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), dtype, device)
    return params


def init_cache(cfg, batch: int, max_seq: int, dtype=None, *, device=None):
    """Zero dense decode cache: ``self`` (k, v) (L, B, max_seq, Nkv, H),
    ``cross`` (k, v) (L, B, encoder_seq, Nkv, H), ``pos`` (B,); every leaf
    its own storage."""
    device = resolve_device(device)
    dt = T._dtype(cfg, dtype)
    lead = (cfg.num_layers,)
    return {
        "self": T._cache_leaves(cfg, lead, batch, max_seq, dt, device,
                                kind="gqa"),
        "cross": T._cache_leaves(cfg, lead, batch, cfg.encoder_seq, dt,
                                 device, kind="gqa"),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def cache_family(cfg) -> str | None:
    """Enc-dec stacks must declare their family (``cache_family='encdec'``):
    the cross cache is a shared read-only segment, not derivable."""
    return getattr(cfg, "cache_family", "") or None


def supports_paged(cfg) -> bool:
    return cache_family(cfg) == "encdec"


def init_paged_cache(cfg, num_blocks: int, block_size: int, dtype=None, *,
                     num_slabs: int = 0, num_segments: int = 0, device=None):
    """``self`` -- the decoder's growing self-attention (k, v) block pools
    (L, NB, BS, Nkv, H); ``cross`` -- the cross-attention (k, v) segment
    pools (L, NSeg, encoder_seq, Nkv, H), read-only after prefill and
    shared by every stream decoding against the same encoder output.  One
    buffer per leaf."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged decode cache unsupported for family={cfg.family!r}")
    device = resolve_device(device)
    dt = T._dtype(cfg, dtype)
    lead = (cfg.num_layers,)
    return {
        "self": T._cache_leaves(cfg, lead, num_blocks, block_size, dt,
                                device, kind="gqa"),
        "cross": T._cache_leaves(cfg, lead, num_segments, cfg.encoder_seq,
                                 dt, device, kind="gqa"),
    }


def paged_pool_kinds(cfg) -> dict[str, str]:
    return {"self": "block", "cross": "segment"}


def paged_insert_views(cfg, prefill_cache) -> dict:
    return {"self": prefill_cache["self"], "cross": prefill_cache["cross"]}


def _shard_self(self_cache):
    """The reference's shard point on the decoder's self K/V (identity
    without rules, and on plain tensors)."""
    return tuple(shd.shard_cache_seq(a, batch_axis=1, seq_axis=2)
                 for a in self_cache)


def encode(cfg, params, frames):
    """frames (B, T_enc, D), precomputed embeddings (the frontend stub) ->
    the encoder output (B, T_enc, D): bidirectional attention on the flash
    kernel with no mask."""
    b, t, _ = frames.shape
    pos = torch.arange(t, device=frames.device).expand(b, t)
    x = frames + L.sinusoidal_positions(pos, cfg.d_model).to(frames.dtype)
    x = shd.shard_hidden(x)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    for lp in T._layers(params["encoder"], cfg.encoder_layers):
        h = L.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
        p = lp["attn"]
        q, k, v = (L._project(h, p[w]) for w in ("wq", "wk", "wv"))
        o = flash_attention(q, k, v, causal=False, scale=scale)
        x = x + torch.matmul(o.reshape(b, t, -1),
                             p["wo"].reshape(-1, cfg.d_model))
        h = L.rms_norm(x, lp["ln2"]["scale"], cfg.norm_eps)
        x = shd.shard_hidden(x + L.mlp(cfg, lp["mlp"], h))
    return L.rms_norm(x, params["enc_norm"]["scale"], cfg.norm_eps)


def _cross_attention(cfg, p, x, k, v, *, lengths=None, row_ids=None):
    """x (B, S, D) attends to the encoder's K/V with no mask.  Prefill and
    train: k/v (B, T_enc, Nkv, H) on the flash kernel.  Decode (S = 1,
    ``lengths`` (B,) all T_enc): k/v the dense cross cache (B, T_enc, ...)
    or, with ``row_ids`` (B,), a segment pool (NSeg, T_enc, ...) of which
    row b reads segment ``row_ids[b]``, on the decode kernel."""
    b, s, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q = L._project(x, p["wq"])
    if lengths is None:
        o = flash_attention(q, k, v, causal=False, scale=scale)
    else:
        o = decode_attention(q[:, 0], k, v, lengths, scale=scale,
                             row_ids=row_ids)[:, None]
    return torch.matmul(o.reshape(b, s, -1), p["wo"].reshape(-1, cfg.d_model))


def forward(cfg, params, batch, *, mode: str, cache=None, remat: bool = False,
            remat_policy: str | None = None):
    """batch: 'tokens' (B,S); 'frames' (B,T_enc,D) for train and prefill;
    optional 'lengths' (B,) true prompt lengths of a padded prefill and
    'max_seq' (the prefill cache's padded length).  Decode takes the dense
    cache of :func:`init_cache` or, when the cache holds ``block_tables``,
    the pools of :func:`init_paged_cache` with ``block_tables`` (B, W),
    ``segment_ids`` (B,) and ``pos`` (B,).  Returns (logits, new_cache,
    aux_loss).  ``remat`` checkpoints each decoder layer, as the
    reference's ``jax.checkpoint`` of its decoder body does
    (``transformer.remat_layer``); the encoder is not."""
    x = shd.shard_hidden(T.embed_tokens(cfg, params, batch["tokens"]))
    b, s, _ = x.shape
    decode = mode == "decode"
    if decode:
        positions = cache["pos"][:, None]
    else:
        positions = torch.arange(s, device=x.device).expand(b, s)
    x = x + L.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    paged = decode and "block_tables" in cache
    if decode:  # the cross K/V come from the cache: every frame is live
        enc = None
        enc_len = torch.full((b,), cache["cross"][0].shape[2],
                             dtype=torch.int32, device=x.device)
        segs = cache["segment_ids"] if paged else None
    else:
        enc = encode(cfg, params, batch["frames"])
    stack = params["decoder"]
    ks, vs, cks, cvs = [], [], [], []  # the prefill cache, per layer

    def layer(li, lp, x, enc, lc, step):
        """Decoder layer ``li``: self-attention against ``lc``, then
        cross-attention to ``enc`` (or, in decode, the cross cache)."""
        h = L.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
        out, c = L.attention(cfg, lp["attn"], h, positions=positions,
                             cache="build" if mode == "prefill" else None,
                             layer_cache=lc, step=step)
        x = x + out
        h = L.rms_norm(x, lp["ln_x"]["scale"], cfg.norm_eps)
        if decode:
            ck, cv = (t[li] for t in cache["cross"])
            x = x + _cross_attention(cfg, lp["cross"], h, ck, cv,
                                     lengths=enc_len, row_ids=segs)
        else:
            ck = L._project(enc, lp["cross"]["wk"])
            cv = L._project(enc, lp["cross"]["wv"])
            x = x + _cross_attention(cfg, lp["cross"], h, ck, cv)
        h = L.rms_norm(x, lp["ln2"]["scale"], cfg.norm_eps)
        return x + L.mlp(cfg, lp["mlp"], h), c, ck, cv

    run_layer = T.remat_layer(layer, remat, remat_policy)
    for li, lp in enumerate(T._layers(stack, cfg.num_layers)):
        if paged:
            lc = (*cache["self"], li, cache["block_tables"], cache["pos"])
        elif decode:
            lc = (*(t[li] for t in cache["self"]), cache["pos"])
        else:
            lc = None
        if li == 0:  # each row's slot and length, shared by every layer
            step = L.attention_step(cfg, positions, lc)
        x, c, ck, cv = run_layer(li, lp, x, enc, lc, step)
        if mode == "prefill":
            ks.append(c[0])
            vs.append(c[1])
            cks.append(ck)
            cvs.append(cv)

    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = T.unembed(cfg, params, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if mode == "train":
        return logits, None, aux
    if decode:
        out = {k: cache[k] for k in ("self", "cross", "block_tables",
                                     "segment_ids") if k in cache}
        out["pos"] = cache["pos"] + 1
        out["self"] = _shard_self(out["self"])
        return logits, out, aux
    # prefill: the self K/V padded to max_seq; the cross K/V as they are
    max_seq = batch.get("max_seq", s)
    lengths = batch.get("lengths")
    return logits, {
        "self": _shard_self((T.pad_seq(torch.stack(ks), 2, max_seq),
                             T.pad_seq(torch.stack(vs), 2, max_seq))),
        "cross": (torch.stack(cks), torch.stack(cvs)),
        "pos": (lengths.to(torch.int32) if lengths is not None
                else torch.full((b,), s, dtype=torch.int32, device=x.device)),
    }, aux
