"""What every reference shares: fp32 with TF32 off, RMS norm, rotary
embeddings (rotate-half pairs), causal softmax attention, SwiGLU, and a
walk over the layers that upcasts one layer's weights at a time from the
served copy, so a reference fits beside the program's weights."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32_exact():
    """No TF32 in matmuls or convolutions while the reference runs."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


def upcast(tree, cast=None):
    """Every leaf of ``tree`` as fp32 (through ``cast`` when given: the
    control's lower precision)."""
    if isinstance(tree, dict):
        return {k: upcast(v, cast) for k, v in tree.items()}
    t = tree.float()
    return cast(t) if cast is not None else t


def layer(stack, i: int):
    """Layer ``i`` of a tree whose leaves stack the layers on axis 0."""
    if isinstance(stack, dict):
        return {k: layer(v, i) for k, v in stack.items()}
    return stack[i]


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x (S, N, D) at positions 0..S-1: pairs (i, i + D/2) rotated by
    position * theta^(-2i/D)."""
    s, _, dim = x.shape
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64,
                                  device=x.device) / dim)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., : dim // 2], x[..., dim // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, scale: float):
    """q, k (S, N, Dk), v (S, N, Dv) -> (S, N, Dv), softmax in fp32."""
    s = q.shape[0]
    scores = torch.einsum("qnd,knd->nqk", q, k) * scale
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    scores.masked_fill_(mask, float("-inf"))
    return torch.einsum("nqk,knd->qnd", torch.softmax(scores, -1), v)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def head_logits(xs, starts, norm, head, eps: float):
    """The final norm and the LM head at positions ``start..`` of each
    sequence's hidden states ``xs``."""
    return [rms_norm(x[s:], norm, eps) @ head for x, s in zip(xs, starts)]


def scale(dim: int) -> float:
    return 1.0 / math.sqrt(dim)
