"""Shared model layers of the port: norms, rotary embeddings, attention
(GQA/MQA and MLA with absorbed decode) and MLPs.

Counterpart of ``repro/models/layers.py``.  Parameters are plain dicts of
tensors in the reference layouts (``wq``/``wk``/``wv`` (d, n, hd), ``wo``
(n, hd, d); MLA's ``w_dkv`` (d, r + pr), ``w_uk`` (r, n, pn), ``w_uv``
(r, n, hv)).  Attention runs on the port's kernels: causal prefill on
``flash_attention``; GQA paged decode on ``paged_decode_attention`` and
dense decode on ``decode_attention``; MLA decode, paged and dense alike, on
``paged_mla_decode_attention``; every norm on ``rmsnorm``.  On CPU tensors
each takes its plain version.  Decode caches and pools are updated in
place.  Absolute sinusoidal positions (whisper) are added at the
embedding; Qwen2-VL's M-RoPE drives each rotary pair from one of three
position streams.

The values every attention layer of one forward shares -- the rotary
cos/sin and, in decode, each row's slot and length -- are computed once
per step by :func:`step_values` and passed down as ``step``; a layer
called without them computes its own.

The new token's write into a dense decode cache (:func:`write_token`)
scatters under either value of ``perf`` flag ``cache_update``.  On
DTensors (a sharded decode step) each rank writes its own shard of the
cache in place, and the decode kernels run on local shards.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.decode_attention import (DEFAULT_BLOCK_K,
                                                  decode_attention)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import sdpa as _sdpa  # noqa: F401
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_mla_decode_attention)
from repro_torch.kernels.rmsnorm import rmsnorm

Params = dict[str, Any]

# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------


def dense_init(generator, shape, dtype, device, *, scale: float | None = None):
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def embed_init(generator, shape, dtype, device):
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rms_norm(x, scale, eps: float):
    """Normalize in fp32, cast to x's dtype, then scale (the reference's
    rounding); runs the rmsnorm kernel on CUDA tensors."""
    return rmsnorm(x.contiguous(), scale, eps)


def init_rms_norm(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------


def _rope_freqs(head_dim: int, theta: float, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python-scalar base: no host-to-device copy (and so no stream sync)
    # in every layer of every step
    return 1.0 / torch.pow(float(theta), exps)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, head_dim/2) in fp32."""
    freqs = _rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions, head_dim: int, theta: float, sections):
    """Qwen2-VL multimodal rotary: ``positions`` (3, B, S) carries the
    temporal/height/width streams; rotary pair d takes the stream of the
    section it falls in, as ``jnp.repeat(arange(3), sections,
    total_repeat_length=head_dim // 2)`` assigns them: sections that sum
    past head_dim/2 are cut off, and pairs past a shorter sum take stream
    2.  Returns cos/sin (B, S, head_dim/2) in fp32."""
    if positions.shape[0] != 3:
        raise ValueError(f"M-RoPE needs (3, B, S) positions, got "
                         f"{tuple(positions.shape)}")
    cos, sin = rope_cos_sin(positions, head_dim, theta)  # (3, B, S, hd/2)
    pair = torch.arange(head_dim // 2, device=positions.device)
    stream = ((pair >= sections[0]).long()
              + (pair >= sections[0] + sections[1]).long())
    idx = stream.expand(1, *cos.shape[1:])
    return cos.gather(0, idx)[0], sin.gather(0, idx)[0]


def apply_rope(x, cos, sin):
    """x (B, S, N, H); cos/sin (B, S, H/2).  Llama-style rotate-half."""
    dt = x.dtype
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def sinusoidal_positions(positions, d_model: int):
    """Whisper-style absolute sinusoidal embeddings, (..., S) -> (..., S, D)
    in fp32: [sin, cos] of positions times exp(-log(1e4) * i / (half - 1))."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / (half - 1))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# values shared by every layer of one step
# --------------------------------------------------------------------------


class StepValues(NamedTuple):
    """What every attention layer of one forward would otherwise recompute:
    the rotary cos/sin (None without rope) and, in decode, the rows
    ``arange(B)``, each row's position as int64, the kernels' lengths
    ``pos + 1`` (int32) and, with block tables, the block and the offset
    that each row's new token is written to."""

    cos: Any = None
    sin: Any = None
    rows: Any = None
    pos: Any = None
    lengths: Any = None
    tables: Any = None
    blk: Any = None
    off: Any = None


def step_values(cfg, positions, *, mrope_positions=None, rope_dim=None,
                pos=None, tables=None, block_size: int = 0) -> StepValues:
    """:class:`StepValues` of one step.  ``positions`` (B, S) drive plain
    rope at ``rope_dim`` (default ``cfg.head_dim``), or M-RoPE when the
    config has it and ``mrope_positions`` (3, B, S) are given.  Decode
    passes ``pos`` (B,), and paged decode (or MLA's dense cache viewed as
    a pool) its block ``tables`` (B, W) int32 over blocks of
    ``block_size`` positions."""
    cos = sin = None
    if cfg.rope_theta:
        dim = rope_dim or cfg.head_dim
        if cfg.mrope and mrope_positions is not None:
            cos, sin = mrope_cos_sin(mrope_positions, dim, cfg.rope_theta,
                                     cfg.mrope_sections)
        else:
            cos, sin = rope_cos_sin(positions, dim, cfg.rope_theta)
    if pos is None:
        return StepValues(cos, sin)
    rows = torch.arange(pos.shape[0], device=pos.device)
    pos_l = pos.long()
    blk = off = None
    if tables is not None:
        blk = tables.long()[rows, pos_l // block_size]
        off = pos_l % block_size
    return StepValues(cos, sin, rows, pos_l, (pos + 1).to(torch.int32),
                      tables, blk, off)


def attention_step(cfg, positions, layer_cache=None,
                   mrope_positions=None) -> StepValues:
    """:func:`step_values` of a GQA layer against ``layer_cache`` (None,
    dense or paged, as :func:`attention` takes it); every layer of the
    step shares them."""
    if layer_cache is None:
        return step_values(cfg, positions, mrope_positions=mrope_positions)
    if len(layer_cache) == 5:
        return step_values(cfg, positions, mrope_positions=mrope_positions,
                           pos=layer_cache[4], tables=layer_cache[3],
                           block_size=layer_cache[0].shape[2])
    return step_values(cfg, positions, mrope_positions=mrope_positions,
                       pos=layer_cache[2])


def mla_step(cfg, positions, layer_cache=None) -> StepValues:
    """:func:`step_values` of an MLA layer against ``layer_cache`` (as
    :func:`mla_attention` takes it): rope at ``qk_rope_head_dim`` and, in
    decode, the slots of the latent pools -- or of the dense (B, Smax, r)
    caches viewed as pools of gcd(Smax, DEFAULT_BLOCK_K) positions through
    identity tables."""
    pr = cfg.qk_rope_head_dim
    if layer_cache is None:
        return step_values(cfg, positions, rope_dim=pr)
    if len(layer_cache) == 5:
        return step_values(cfg, positions, rope_dim=pr, pos=layer_cache[4],
                           tables=layer_cache[3],
                           block_size=layer_cache[0].shape[2])
    pos, smax = layer_cache[2], layer_cache[0].shape[1]
    bk = math.gcd(smax, DEFAULT_BLOCK_K)
    return step_values(cfg, positions, rope_dim=pr, pos=pos,
                       tables=_identity_tables(pos.shape[0], smax, bk,
                                               pos.device),
                       block_size=bk)


# --------------------------------------------------------------------------
# the new token's write into a dense decode cache
# --------------------------------------------------------------------------


def write_token(cache, rows, pos, val) -> None:
    """``cache[rows[b], pos[b]] = val[b]`` in place, for a (R, T, ...)
    cache and ``val`` (B, ...).  Rows that repeat a slot (padding rows
    duplicate row 0) write the same position and value.  On a DTensor
    cache each rank writes its own shard: only the batch (dim 0) and
    position (dim 1) may be sharded.

    The reference chooses this write by ``perf`` flag ``cache_update``:
    "scatter", or "where" (its default), a select over the whole cache
    that only pays under XLA.  Both leave the same values, so the port
    scatters under either: on the H100 the whole-cache select cost a
    24-layer masked-dense decode step about 2 ms more than the scatter."""
    if not isinstance(cache, DTensor):
        cache.index_put_((rows, pos), val.to(cache.dtype))
        return
    off = shd.local_offsets(cache)
    if any(off[2:]) or any(isinstance(p, Shard) and p.dim > 1
                           for p in cache.placements):
        raise ValueError(f"write_token: a cache sharded past its position "
                         f"dim: {cache.placements}")
    rows, pos, val = (shd.to_full(t) for t in (rows, pos, val))
    _write_local(cache.to_local(), off[0], off[1], cache.shape[0], rows,
                 pos, val.to(cache.dtype))


def _write_local(local, off0: int, off1: int, nrows: int, rows, pos,
                 val) -> None:
    """:func:`write_token` into ``local``, the block of a (nrows, T, ...)
    cache that starts at slot ``off0``, position ``off1``.  Each local slot
    finds the row that writes it (if any) through an inverse map of
    ``rows``, so no two writes meet and nothing waits on the host; a slot
    with no write, or whose position lies in another rank's block, writes
    back what it holds."""
    n0, n1 = local.shape[:2]
    dev = local.device
    owner = torch.full((nrows,), -1, dtype=torch.long, device=dev)
    owner[rows.long()] = torch.arange(rows.shape[0], device=dev)
    own = owner[off0:off0 + n0]
    src = own.clamp(min=0)
    t = pos.long()[src] - off1  # (n0,) each slot's position, local
    hit = (own >= 0) & (t >= 0) & (t < n1)
    slot = torch.arange(n0, device=dev)
    tc = t.clamp(0, n1 - 1)
    tail = [1] * (local.dim() - 2)
    local.index_put_((slot, tc), torch.where(hit.view(n0, *tail), val[src],
                                             local[slot, tc]))


# --------------------------------------------------------------------------
# attention (GQA / MQA)
# --------------------------------------------------------------------------


def init_attention(cfg, generator, dtype, device) -> Params:
    d, nq, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(generator, (d, nq, hd), dtype, device),
        "wk": dense_init(generator, (d, nkv, hd), dtype, device),
        "wv": dense_init(generator, (d, nkv, hd), dtype, device),
        "wo": dense_init(generator, (nq, hd, d), dtype, device,
                         scale=1.0 / math.sqrt(nq * hd)),
    }


def _project(x, w):
    """x (B, S, d) @ w (d, n, h) -> (B, S, n, h)."""
    d, n, h = w.shape
    out = shd.whole_heads(shd.dense(x, shd.merge_heads(w, 1)), n)
    return out.view(*x.shape[:-1], n, h)


def attention(cfg, p: Params, x, *, positions, cache=None, layer_cache=None,
              mrope_positions=None, step: StepValues | None = None,
              scale: float | None = None):
    """GQA attention.  Rotary positions are ``positions`` (B, S), or
    ``mrope_positions`` (3, B, S) for a config with M-RoPE; ``step`` holds
    this step's shared values (:func:`step_values`), else they are computed
    here.  ``scale`` is the softmax scale, 1/sqrt(head_dim) when None (a
    config such as granite-4.0-h's states its own).

    Training/prefill: ``layer_cache is None`` -> causal self-attention; if
    ``cache == 'build'`` also returns the (k, v) for cache construction.
    Decode: ``layer_cache = (k_cache, v_cache, pos)`` with x of seq-len 1;
    the new token is written into the caches in place; returns (out,
    (k_cache, v_cache)).
    Paged decode: ``layer_cache = (k_stack, v_stack, lidx, block_tables,
    pos)`` with the layer-stacked pools (L, num_blocks, block_size, Nkv, H)
    shared across rows, ``lidx`` this layer's index and ``block_tables``
    (B, W) int32 each row's blocks; the new token is written into the pools
    in place; returns (out, (k_stack, v_stack)).
    """
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    q = shd.shard_heads(q)
    if step is None:
        step = attention_step(cfg, positions, layer_cache, mrope_positions)
    if step.cos is not None:  # else absolute positions came at the embedding
        q = apply_rope(q, step.cos, step.sin)
        k = apply_rope(k, step.cos, step.sin)

    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if layer_cache is None:
        out = flash_attention(q, k, v, causal=True, scale=scale)
        new_cache = (k, v) if cache == "build" else None
    elif len(layer_cache) == 5:
        # Rows never share a tail block (the paged KV manager copy-on-write
        # forks shared tails), so the scatter is row-disjoint; padding rows
        # duplicate row 0 and write identical values.
        k_stack, v_stack, lidx, tables, _ = layer_cache
        k_stack[lidx].index_put_((step.blk, step.off),
                                 k[:, 0].to(k_stack.dtype))
        v_stack[lidx].index_put_((step.blk, step.off),
                                 v[:, 0].to(v_stack.dtype))
        out = paged_decode_attention(q[:, 0], k_stack[lidx], v_stack[lidx],
                                     tables, step.lengths,
                                     scale=scale)[:, None]
        new_cache = (k_stack, v_stack)
    else:
        k_cache, v_cache, _ = layer_cache  # (B, Smax, Nkv, H), pos (B,)
        write_token(k_cache, step.rows, step.pos, k[:, 0])
        write_token(v_cache, step.rows, step.pos, v[:, 0])
        out = decode_attention(q[:, 0], k_cache, v_cache, step.lengths,
                               scale=scale)[:, None]
        new_cache = (k_cache, v_cache)

    out = torch.matmul(shd.merge_heads(out, 2), shd.merge_heads(p["wo"], 0))
    return shd.shard_hidden(out), new_cache


# --------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# --------------------------------------------------------------------------


def init_mla(cfg, generator, dtype, device) -> Params:
    d, n = cfg.d_model, cfg.num_heads
    r, pr, pn, hv = (cfg.kv_lora_rank, cfg.qk_rope_head_dim,
                     cfg.qk_nope_head_dim, cfg.v_head_dim)
    return {
        "wq": dense_init(generator, (d, n, pn + pr), dtype, device),
        # latent + shared rope key
        "w_dkv": dense_init(generator, (d, r + pr), dtype, device),
        "w_uk": dense_init(generator, (r, n, pn), dtype, device),
        "w_uv": dense_init(generator, (r, n, hv), dtype, device),
        "wo": dense_init(generator, (n, hv, d), dtype, device,
                         scale=1.0 / math.sqrt(n * hv)),
    }


def _per_head(x, w):
    """x (B, N, a) and w (a, N, c) -> (B, N, c): one product per head,
    batched over N on the weight's own layout (no copy of w)."""
    return torch.bmm(x.transpose(0, 1), w.transpose(0, 1)).transpose(0, 1)


def _identity_tables(b: int, smax: int, bk: int, device):
    """Block tables that view a dense (B, Smax, ...) cache as a pool of
    (B * Smax / bk) blocks of bk positions: row b owns blocks b*W..b*W+W-1."""
    w = smax // bk
    return (torch.arange(b, device=device)[:, None] * w
            + torch.arange(w, device=device)[None, :]).to(torch.int32)


def _dense_mla_decode(q_lat, q_rope, ckv_cache, krope_cache, step, scale):
    """The MLA decode kernel over dense (B, Smax, r) / (B, Smax, pr) caches
    viewed as pools of gcd(Smax, DEFAULT_BLOCK_K) positions through
    identity tables.  On DTensors it runs on local shards: rows where the
    cache's batch is sharded, heads where they divide, the rest gathered;
    each rank's tables view its own rows."""
    def local(q_lat, q_rope, ckv, krope, lengths, tables=None):
        smax = ckv.shape[1]
        bk = math.gcd(smax, DEFAULT_BLOCK_K)
        if tables is None:
            tables = _identity_tables(ckv.shape[0], smax, bk, ckv.device)
        return paged_mla_decode_attention(
            q_lat, q_rope, ckv.view(-1, bk, ckv.shape[-1]),
            krope.view(-1, bk, krope.shape[-1]), tables, lengths, scale=scale)

    mesh = shd.mesh_of(q_lat, ckv_cache)
    if mesh is None:
        return local(q_lat, q_rope, ckv_cache, krope_cache, step.lengths,
                     step.tables)

    plan = shd.kernel_plan(mesh, ckv_cache, (q_lat.shape[1],))
    qp = shd.plan_placements(plan, batch=Shard(0), heads=Shard(1))
    cp = shd.plan_placements(plan, batch=Shard(0))
    args = tuple(shd.as_dtensor(t, mesh) for t in
                 (q_lat, q_rope, ckv_cache, krope_cache, step.lengths))
    return shd.local_call(local, args, (qp, qp, cp, cp, cp), qp)


def mla_attention(cfg, p: Params, x, *, positions, cache=None,
                  layer_cache=None, step: StepValues | None = None):
    """MLA: KV compressed to a ``kv_lora_rank`` latent plus one shared
    rotary key; the cache stores only (c_kv, k_rope).

    Training/prefill: ``layer_cache is None`` -> causal attention with the
    decompressed keys (width qk_nope + qk_rope) and values (v_head_dim) on
    the flash kernel; ``cache == 'build'`` also returns (c_kv, k_rope).
    Paged decode: ``layer_cache = (ckv_stack, krope_stack, lidx, tables,
    pos)`` with latent pools (L, NB, BS, r) / (L, NB, BS, pr) shared across
    rows.  Dense decode: ``layer_cache = (ckv_cache, krope_cache, pos)``
    (B, Smax, r) / (B, Smax, pr), viewed as a block pool with an identity
    table.  Both decode branches write the new row in place and run the
    absorbed formulation (queries projected into the latent space) on the
    same kernel, so they do the same arithmetic per row.  ``step`` holds
    this step's shared values (:func:`mla_step`), else they are computed
    here.
    """
    b, s, _ = x.shape
    n = cfg.num_heads
    r, pr, pn = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim
    # the model's scale: the QK head dim, not the kernel's (r + pr) default
    scale = 1.0 / math.sqrt(pn + pr)

    q = _project(x, p["wq"])  # (B, S, N, pn + pr)
    q_nope, q_rope = q[..., :pn], q[..., pn:]
    ckv_full = torch.matmul(x, p["w_dkv"])  # (B, S, r + pr)
    c_kv, k_rope = ckv_full[..., :r], ckv_full[..., r:]

    if step is None:
        step = mla_step(cfg, positions, layer_cache)
    q_rope = apply_rope(q_rope, step.cos, step.sin)
    k_rope = apply_rope(k_rope[:, :, None, :], step.cos, step.sin)[:, :, 0, :]

    if layer_cache is None:
        k_nope = _project(c_kv, p["w_uk"])
        v = _project(c_kv, p["w_uv"])
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, n, pr)],
                      dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        out = flash_attention(qq, k, v, causal=True, scale=scale)
        # c_kv is a view into ckv_full: the cache keeps a contiguous copy,
        # which dense decode views as a block pool
        new_cache = (c_kv.contiguous(), k_rope) if cache == "build" else None
        out = shd.merge_heads(out, 2)
    else:
        # absorbed decode: q_nope @ w_uk -> latent space, in x's dtype
        q_lat = _per_head(q_nope[:, 0], p["w_uk"].permute(2, 1, 0)).contiguous()
        q_rope = q_rope[:, 0].contiguous()
        if len(layer_cache) == 5:
            # Rows never share a tail block (copy-on-write forks), so the
            # scatter is row-disjoint; padding rows duplicate row 0.
            ckv_stack, krope_stack, lidx = layer_cache[:3]
            ckv_pool, krope_pool = ckv_stack[lidx], krope_stack[lidx]
            ckv_pool.index_put_((step.blk, step.off),
                                c_kv[:, 0].to(ckv_pool.dtype))
            krope_pool.index_put_((step.blk, step.off),
                                  k_rope[:, 0].to(krope_pool.dtype))
            new_cache = (ckv_stack, krope_stack)
            o_lat = paged_mla_decode_attention(
                q_lat, q_rope, ckv_pool, krope_pool, step.tables,
                step.lengths, scale=scale)
        else:  # dense (B, Smax, ...) caches
            ckv_cache, krope_cache, _ = layer_cache
            new_cache = (ckv_cache, krope_cache)
            write_token(ckv_cache, step.rows, step.pos, c_kv[:, 0])
            write_token(krope_cache, step.rows, step.pos, k_rope[:, 0])
            o_lat = _dense_mla_decode(q_lat, q_rope, ckv_cache, krope_cache,
                                      step, scale)
        out = shd.merge_heads(_per_head(o_lat, p["w_uv"]), 1)[:, None]

    out = torch.matmul(out, shd.merge_heads(p["wo"], 0))
    return shd.shard_hidden(out), new_cache


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def init_mlp(cfg, generator, dtype, device, d_ff: int | None = None) -> Params:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": dense_init(generator, (d, f), dtype, device),
            "w_up": dense_init(generator, (d, f), dtype, device),
            "w_down": dense_init(generator, (f, d), dtype, device),
        }
    return {  # gelu
        "w_up": dense_init(generator, (d, f), dtype, device),
        "w_down": dense_init(generator, (f, d), dtype, device),
    }


def mlp(cfg, p: Params, x):
    if "w_gate" in p:
        h = F.silu(shd.dense(x, p["w_gate"])) * shd.dense(x, p["w_up"])
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(shd.dense(x, p["w_up"]), approximate="tanh")
    h = shd.shard_ffn(shd.reduce_partial_rows(h))
    return torch.matmul(h, p["w_down"])
