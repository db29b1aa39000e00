"""Shared model layers of the port, GQA subset: norms, rotary embeddings,
attention and MLPs.

Counterpart of ``repro/models/layers.py``.  Parameters are plain dicts of
tensors in the reference layouts (``wq``/``wk``/``wv`` (d, n, hd), ``wo``
(n, hd, d)).  Attention runs on the port's kernels: causal prefill on
``flash_attention``, paged decode on ``paged_decode_attention``, dense
decode on ``decode_attention``, and every norm on ``rmsnorm``; on CPU
tensors each takes its plain version.  Decode caches and pools are updated
in place.  MLA, M-RoPE and sinusoidal positions come with later slices.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import sdpa as _sdpa  # noqa: F401
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
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


def apply_rope(x, cos, sin):
    """x (B, S, N, H); cos/sin (B, S, H/2).  Llama-style rotate-half."""
    dt = x.dtype
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


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
    return torch.matmul(x, w.reshape(d, n * h)).view(*x.shape[:-1], n, h)


def attention(cfg, p: Params, x, *, positions, cache=None, layer_cache=None):
    """GQA attention.

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
    if cfg.rope_theta:  # else absolute positions were added at the embedding
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    scale = 1.0 / math.sqrt(hd)
    if layer_cache is None:
        out = flash_attention(q, k, v, causal=True, scale=scale)
        new_cache = (k, v) if cache == "build" else None
    elif len(layer_cache) == 5:
        # Rows never share a tail block (the paged KV manager copy-on-write
        # forks shared tails), so the scatter is row-disjoint; padding rows
        # duplicate row 0 and write identical values.
        k_stack, v_stack, lidx, tables, pos = layer_cache
        bs_blk = k_stack.shape[2]
        pos_l = pos.long()
        rows = torch.arange(b, device=x.device)
        blk = tables.long()[rows, pos_l // bs_blk]
        off = pos_l % bs_blk
        k_stack[lidx].index_put_((blk, off), k[:, 0].to(k_stack.dtype))
        v_stack[lidx].index_put_((blk, off), v[:, 0].to(v_stack.dtype))
        out = paged_decode_attention(q[:, 0], k_stack[lidx], v_stack[lidx],
                                     tables, (pos + 1).to(torch.int32),
                                     scale=scale)[:, None]
        new_cache = (k_stack, v_stack)
    else:
        k_cache, v_cache, pos = layer_cache  # (B, Smax, Nkv, H), pos (B,)
        rows = torch.arange(b, device=x.device)
        k_cache.index_put_((rows, pos.long()), k[:, 0].to(k_cache.dtype))
        v_cache.index_put_((rows, pos.long()), v[:, 0].to(v_cache.dtype))
        out = decode_attention(q[:, 0], k_cache, v_cache,
                               (pos + 1).to(torch.int32), scale=scale)[:, None]
        new_cache = (k_cache, v_cache)

    nq = out.shape[2]
    out = torch.matmul(out.reshape(b, s, nq * hd),
                       p["wo"].reshape(nq * hd, -1))
    return out, new_cache


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
        h = F.silu(torch.matmul(x, p["w_gate"])) * torch.matmul(x, p["w_up"])
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(torch.matmul(x, p["w_up"]), approximate="tanh")
    return torch.matmul(h, p["w_down"])
